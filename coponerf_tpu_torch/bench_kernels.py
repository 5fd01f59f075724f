"""Times the port's kernels at the main paths' shapes, a render, an
evaluation image and the fast train step on one card.

    python -m coponerf_tpu_torch.bench_kernels [--steps 5]

Prints one JSON line with:
- ``train_k1``: ``bilinear_sample`` (K1) at the training shape, ms per
  call for each small level (16^2, 32^2, 64^2 x 256, 12 rows x 192 rays x
  64 samples) in both padding modes, and the six calls' sum;
  ``train_k1_device``: the same calls' kernel time alone, device ms under
  ``torch.profiler`` (a diagnostic: the wrapper's host time is left out);
- ``stage_a``: per sample set of inference stage A (2 view rows, 16 x
  32768 points, the four render levels), ``multilevel_sample`` (K8a, one
  launch) and the four one-level ``bilinear_sample`` calls, in turns;
- ``k8b``: ``grid_sample_window`` (K8b) on the 256^2 x 64 level at stage
  A's points, f32 output, ms per call in both padding modes;
- ``train_k4``: ``onehot_transpose_matmul`` (K4) at the training shape,
  ms per call for each small level in both padding modes (bf16
  cotangents, corners from the ray-major training points), and the six
  calls' sum;
- ``attn_embed``: ``round1_logits`` and ``round2_logits`` (K7a, K7b) at
  cf[16,4]'s stage A (S 16) and stage B (S 4): 2 view rows x S x 32768
  tokens, ms per call;
- ``split_dense_relu``: K2 (``split_dense_relu``) at stage A (bf16,
  1,048,576 rows), the exact evaluation's shape (f32, 524,288 rows) and
  the train step's (bf16, 147,456 rows), ms per call;
- ``render_core_chunk_ms``: ``render_core`` (K6) on one single-stage
  chunk (B 1, V 2, S 64, 32768 rays), ms per call;
- ``render_cf16_4_ms`` and ``render_cf16_4_attn_embed_ms``: one 256^2
  request in the fast config (cf[16,4], two 32768-ray chunks, encode
  excluded), unfused and with ``fusion="attn_embed"``, in turns, ms per
  image (median of three turns; ``render_cf16_4_turns_ms`` has each turn,
  and ``render_cf16_4_kernel_ms`` the device kernel time of one more
  request of each under ``torch.profiler``);
- ``render_single_stage_ms`` and ``render_core_single_stage_ms``: the same
  request in the single-stage fast config (S 64), unfused and with
  ``fusion="render_core"``, in turns, ms per image;
- ``eval_single_stage_ms`` and ``eval_exact_ms``: one synthetic 256^2 pair
  through ``eval.harness.evaluate`` in the test entry's fast config
  (single stage, S 64, 32768-ray chunks) and in its default exact config
  (f32, 4096-ray chunks), encode plus render ms per image;
- ``k5``: ``soft_argmax_stats`` (K5's forward) on a cosine-like (B, 4096,
  4096) f32 volume at B 6 (the fused train step) and B 1 (the fused
  encode), by CUDA events and by device time under ``torch.profiler``
  summed over all of a call's launches (``device_ms``, with the launches
  a call makes and the device ms of each kernel name in ``by_kernel``);
  ``soft_argmax_bwd`` (K5's backward) at B 6 the same way; and
  ``encode_fused_ms``, one 256^2 pair's ``encode()`` in the fast config
  with ``fused_argmax=True`` (host clock, median of three);
- ``train_step``: the fast-config train step at batch 6 x 256^2 pairs
  (pose + cycle + SSIM), the host-clock ms of each timed step, and one
  step's device kernel time under ``torch.profiler``, in all and in the
  sampler's kernels; ``adam_state_leaves``, the parameters that hold Adam
  state after the steps; ``leaves``, one backward's count of parameters
  and values, those that no loss reaches (``gradless``, with their
  names) and those it does (``reached``: the flat all-reduce's buffer
  under a mesh);
- ``dp_step``: the same step and batch over a one-rank NCCL mesh
  (``train_step(..., mesh=...)``) and without one, from the same
  weights, in turns, host-clock ms of each timed step; and the flat
  gradient all-reduce (``parallel.mesh.average_gradients``) alone on
  random gradients of the reached parameters and of all parameters,
  CUDA events.

Kernel times are CUDA events around 10 back-to-back calls, the median of 5
such windows; the render and the evaluations are host-clock times up to
``torch.cuda.synchronize()`` after a warm-up call, the median of three
(the exact evaluation: one).  Run it in two checkouts of the repo in turns
on one card (A, B, B, A) to compare them: it uses only entry points both
have (the samplers, ``onehot_transpose_matmul``, ``round1_logits``,
``round2_logits``, ``split_dense_relu``, ``render_core``,
``soft_argmax_stats``, ``soft_argmax_bwd``, ``encode``, ``render``,
``evaluate``, ``train_step`` and the mesh's ``init_distributed``,
``make_mesh`` and ``average_gradients``).  ``--only`` runs some sections alone.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

IMAGE = 256
CHUNK = 32768
TRAIN_ROWS = 12
TRAIN_RAYS = 192
SAMPLER_KERNEL = "multilevel_sample_kernel"  # every xy sampling launch (K1, K8a, K8b)
K5_KERNEL = "soft_argmax"                    # every K5 launch, forward and backward
SECTIONS = ("samplers", "k4", "attn_embed", "split_dense", "render_core", "k5", "render_eval", "train_step",
            "dp_step")


def cuda_ms_in_turns(fns, reps: int = 5, inner: int = 10):
    """Median ms per call of each of ``fns``, timed in turns (the order
    reversed every other window)."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for r in range(reps):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fns[i]()
            b.record()
            b.synchronize()
            times[i].append(a.elapsed_time(b) / inner)
    return [statistics.median(t) for t in times]


def kernel_profile(fn, kernel: str = "", calls: int = 20, launches: int | None = None) -> dict:
    """{kernel name: (device ms, launches)} per call of ``fn`` for kernels
    whose name holds ``kernel`` (by default all), under ``torch.profiler``
    over ``calls`` back-to-back calls after a warm-up call.  The profiler
    can drop a record or two of a session, so a kernel's launches a call
    are its count over the calls, rounded, and its device ms a call the
    mean time of its launches times those.  Where ``launches`` (such
    kernels a call launches) is given, a profile that shows another number
    is taken again, up to three times, then the result is empty."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key and e.count]
        found = {e.key: (e.self_device_time_total / 1e3 / e.count * round(e.count / calls), round(e.count / calls))
                 for e in events}
        if launches is None or sum(n for _, n in found.values()) == launches:
            return found
    return {}


def device_ms(fn, kernel: str = "", calls: int = 20, launches: int | None = None) -> float:
    """Device ms per call of ``fn`` spent in kernels whose name holds
    ``kernel``, as ``kernel_profile`` takes them; NaN where no profile
    showed ``launches`` launches a call."""
    prof = kernel_profile(fn, kernel, calls, launches)
    return sum(ms for ms, _ in prof.values()) if prof else float("nan")


def train_grid(gen, dev, shift: float) -> torch.Tensor:
    """(rows, rays * 64, 2) points, ray-major, each ray a segment across the image."""
    start = torch.rand(TRAIN_ROWS, TRAIN_RAYS, 1, 2, device=dev, generator=gen) * 0.4 - 1.0 - shift
    end = torch.rand(TRAIN_ROWS, TRAIN_RAYS, 1, 2, device=dev, generator=gen) * 0.4 + 0.6
    t = torch.linspace(0, 1, 64, device=dev)[None, None, :, None]
    return (start + (end - start) * t).reshape(TRAIN_ROWS, TRAIN_RAYS * 64, 2).contiguous()


def stage_a_grid(gen, dev, shift: float) -> torch.Tensor:
    """(2, 16 * 32768, 2) sample-major points: token s * N + n on ray n's
    segment, rays in raster order."""
    n = torch.arange(CHUNK, device=dev, dtype=torch.float32)
    u = (n % IMAGE) / (IMAGE - 1) * 2 - 1
    v = (n // IMAGE) / (IMAGE - 1) * 2 - 1
    start = torch.stack([(u + 1) / 2 - 0.95 - shift, v * 0.9], -1)
    direction = torch.randn(2, 1, 2, device=dev, generator=gen) * 0.2 + torch.tensor([0.9, 0.1], device=dev)
    t = torch.linspace(0, 1, 16, device=dev)
    return (start[None, None] + t[None, :, None, None] * direction[:, :, None, :]).reshape(2, -1, 2).contiguous()


def time_samplers(dev) -> dict:
    from coponerf_tpu_torch.ops.bilinear_sample import bilinear_sample, grid_sample_window, multilevel_sample

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"train_k1": {}, "train_k1_device": {}, "stage_a": {}}
    for hw in (16, 32, 64):
        table = torch.randn(TRAIN_ROWS, hw, hw, 256, device=dev, generator=gen).bfloat16()
        for mode, shift in (("border", 0.0), ("zeros", 0.3)):
            grid = train_grid(gen, dev, shift)
            key = f"{hw}x{hw}x256 {mode}"
            (out["train_k1"][key],) = cuda_ms_in_turns([lambda: bilinear_sample(table, grid, mode)])
            out["train_k1_device"][key] = device_ms(lambda: bilinear_sample(table, grid, mode), SAMPLER_KERNEL,
                                                    launches=1)
    for k in ("train_k1", "train_k1_device"):
        out[k]["six_calls"] = sum(out[k].values())
    tables = [torch.randn(2, hw, hw, c, device=dev, generator=gen).bfloat16()
              for hw, c in ((16, 256), (32, 256), (64, 256), (IMAGE, 64))]
    for mode, shift in (("border", 0.0), ("zeros", 0.4)):
        grid = stage_a_grid(gen, dev, shift)
        ml, four = cuda_ms_in_turns([lambda: multilevel_sample(tables, grid, mode),
                                     lambda: [bilinear_sample(t, grid, mode) for t in tables]])
        out["stage_a"][mode] = {"multilevel_sample": ml, "four_bilinear_sample": four}
    out["k8b"] = {}
    for mode, shift in (("border", 0.0), ("zeros", 0.4)):
        grid = stage_a_grid(gen, dev, shift)
        (out["k8b"][mode],) = cuda_ms_in_turns([lambda: grid_sample_window(tables[-1], grid, mode)])
    return out


def time_k4(dev) -> dict:
    from coponerf_tpu_torch.ops.bilinear_sample import corners_from_pixel_xy, onehot_transpose_matmul, pixel_xy

    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn(TRAIN_ROWS, TRAIN_RAYS * 64, 256, device=dev, generator=gen).bfloat16()
    out = {}
    for hw in (16, 32, 64):
        for mode, shift in (("border", 0.0), ("zeros", 0.3)):
            x, y = pixel_xy(train_grid(gen, dev, shift), hw, hw, mode)
            idx, w = (t.contiguous() for t in corners_from_pixel_xy(x, y, hw, mode != "border"))
            (out[f"{hw}x{hw}x256 {mode}"],) = cuda_ms_in_turns([lambda: onehot_transpose_matmul(g, idx, w, hw * hw)])
    out["six_calls"] = sum(out.values())
    return out


def time_attn_embed(dev) -> dict:
    from coponerf_tpu_torch.ops.attn_embed import round1_logits, round2_logits

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    wq, bq = rnd(16, 128, scale=0.25), rnd(128, scale=0.1)
    wq2, bq2 = rnd(128, 128, scale=128 ** -0.5), rnd(128, scale=0.1)
    fkb, wk2, bk2 = rnd(128, scale=0.1), rnd(128, 128, scale=128 ** -0.5), rnd(128, scale=0.1)
    wra, wrb, br = rnd(128, 128, scale=128 ** -0.5), rnd(16, 128, scale=0.25), rnd(128, scale=0.1)
    wr2, br2 = rnd(128, 128, scale=128 ** -0.5), rnd(128, scale=0.1)
    out = {}
    for stage, S in (("stage_a", 16), ("stage_b", 4)):
        T = S * CHUNK
        ka, kbs = rnd(2, T, 128).bfloat16(), rnd(2, T, 128).bfloat16()
        lc, ze = rnd(2, T, 16).bfloat16(), rnd(1, CHUNK, 128)
        with torch.no_grad():
            r1, r2 = cuda_ms_in_turns([
                lambda: round1_logits(ka, kbs, lc, fkb, wk2, bk2, wq, bq, wq2, bq2),
                lambda: round2_logits(ze, lc, wq, bq, wq2, bq2, wra, wrb, br, wr2, br2, S, 2)])
        out[stage] = {"round1_logits": r1, "round2_logits": r2}
        del ka, kbs, lc, ze
    return out


def time_split_dense(dev) -> dict:
    from coponerf_tpu_torch.ops.split_matmul import split_dense_relu

    gen = torch.Generator(device=dev).manual_seed(0)
    W = torch.randn(835, 832, device=dev, generator=gen) / 835 ** 0.5
    bias = torch.randn(832, device=dev, generator=gen) * 0.1
    fk = torch.randn(832, 128, device=dev, generator=gen) / 832 ** 0.5
    out = {}
    for label, dtype, M in (("stage_a_bf16", torch.bfloat16, 1048576), ("exact_f32", torch.float32, 524288),
                            ("train_bf16", torch.bfloat16, TRAIN_ROWS * TRAIN_RAYS * 64)):
        parts = [torch.randn(1, M, w, device=dev, generator=gen).to(dtype) for w in (256, 256, 256, 64)]
        parts.append(torch.tanh(torch.randn(1, M, 3, device=dev, generator=gen)).to(dtype))
        with torch.no_grad():
            (out[label],) = cuda_ms_in_turns([lambda: split_dense_relu(parts, W, bias, fk)])
        del parts
        torch.cuda.empty_cache()
    return out


def render_core_inputs(dev, S: int = 64, V: int = 2, N: int = CHUNK, seed: int = 0):
    """Seeded arguments of ``render_core`` on one single-stage chunk: the two
    sample sets (relu'd latents, as the sampler gives them), positions,
    local coordinates and the 21 weights, scaled like the model's
    (matrices by 1/sqrt(fan-in), biases 0.1)."""
    from coponerf_tpu_torch.ops.render_core import SPLITS, WEIGHT_SHAPES

    gen = torch.Generator(device=dev).manual_seed(seed)
    T = S * N
    w = [torch.randn(*sh, device=dev, generator=gen) * (0.1 if len(sh) == 1 else sh[0] ** -0.5)
         for _, sh in WEIGHT_SHAPES]
    sets = [[torch.relu(torch.randn(V, T, c, device=dev, generator=gen)).bfloat16() for c in SPLITS]
            for _ in range(2)]
    pt = [torch.randn(V, T, 3, device=dev, generator=gen) * 3 for _ in range(2)]
    lc = torch.randn(V, T, 16, device=dev, generator=gen).bfloat16()
    return (sets[0], pt[0], sets[1], pt[1], lc, *w, S, V, N)


def time_render_core(dev) -> dict:
    from coponerf_tpu_torch.ops.render_core import render_core

    args = render_core_inputs(dev)
    with torch.no_grad():
        (ms,) = cuda_ms_in_turns([lambda: render_core(*args)], reps=5, inner=1)
    return {"render_core_chunk_ms": ms}


def cosine_volume(B: int, n: int, gen, dev) -> torch.Tensor:
    """(B, n, n) f32 cosine correlations of unit features where target token
    s resembles source token s - 97: one sharp peak per row and column."""
    import torch.nn.functional as F

    src = F.normalize(torch.randn(B, n, 64, device=dev, generator=gen), dim=-1)
    trg = F.normalize(src.roll(97, dims=1) + 0.7 * torch.randn(B, n, 64, device=dev, generator=gen), dim=-1)
    return torch.bmm(src, trg.transpose(1, 2)).contiguous()


def time_k5(dev) -> dict:
    from coponerf_tpu_torch.ops.soft_argmax import soft_argmax_bwd, soft_argmax_stats

    gen = torch.Generator(device=dev).manual_seed(0)
    n = (IMAGE // 4) ** 2
    out = {}

    def timed(fn) -> dict:
        (ms,) = cuda_ms_in_turns([fn])
        prof = kernel_profile(fn, K5_KERNEL)
        return {"ms": ms, "device_ms": sum(v[0] for v in prof.values()) if prof else float("nan"),
                "launches": sum(v[1] for v in prof.values()), "by_kernel": {k: v[0] for k, v in prof.items()}}

    for B in (6, 1):
        c = cosine_volume(B, n, gen, dev)
        out[f"fwd_b{B}"] = timed(lambda: soft_argmax_stats(c))
        if B == 6:
            row, col = soft_argmax_stats(c)
            rowf = torch.cat([row[:, :2], row[:, 2:] / row[:, 1:2]], dim=1)
            colf = torch.cat([col[:, :2], col[:, 2:] / col[:, 1:2]], dim=1)
            dr, dcol = (torch.randn(B, 2, n, device=dev, generator=gen) for _ in range(2))
            out["bwd_b6"] = timed(lambda: soft_argmax_bwd(c, rowf, colf, dr, dcol))
            del row, col, rowf, colf
        del c
        torch.cuda.empty_cache()

    from coponerf_tpu_torch.config import ModelConfig
    from coponerf_tpu_torch.data.synthetic import make_batch
    from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
    from coponerf_tpu_torch.utils.init import init_weights

    cfg = ModelConfig(fast_sampling=True, compute_dtype="bfloat16", fused_argmax=True)
    model = init_weights(CoPoNeRF(cfg, image_size=IMAGE).eval(), seed=0).to(dev)
    batch = batch_to_torch(make_batch(batch_size=1, image_size=IMAGE, n_rays=CHUNK, seed=0)[0], dev)
    with torch.no_grad():
        out["encode_fused_ms"] = host_ms(lambda: model.encode(batch))
    return out


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` up to ``torch.cuda.synchronize()``, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_render_and_eval(dev) -> dict:
    import dataclasses
    import warnings

    from coponerf_tpu_torch.config import ModelConfig
    from coponerf_tpu_torch.data.synthetic import make_batch
    from coponerf_tpu_torch.eval.harness import evaluate
    from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
    from coponerf_tpu_torch.utils.init import init_weights

    cfg = ModelConfig(fast_sampling=True, compute_dtype="bfloat16", coarse_samples=16, fine_samples=4)
    model = init_weights(CoPoNeRF(cfg, image_size=IMAGE).eval(), seed=0).to(dev)
    b, g = make_batch(batch_size=1, image_size=IMAGE, n_rays=IMAGE * IMAGE, seed=0, full_query_image=True)
    batch = batch_to_torch(b, dev)
    with torch.no_grad():
        state = model.encode(batch)

        def render(fusion=None):
            for lo in range(0, IMAGE * IMAGE, CHUNK):
                q = dict(batch["query"], uv=batch["query"]["uv"][:, :, lo: lo + CHUNK],
                         rgb=batch["query"]["rgb"][:, :, lo: lo + CHUNK])
                model.render({"context": batch["context"], "query": q}, state, val=True, fusion=fusion)

        render(None)
        render("attn_embed")
        cf_times = {None: [], "attn_embed": []}
        for r in range(3):               # in turns, the order reversed every other round
            for fusion in ((None, "attn_embed") if r % 2 == 0 else ("attn_embed", None)):
                cf_times[fusion].append(host_ms(lambda: render(fusion), reps=1))
        cf_kernel_ms = {str(f): device_ms(lambda: render(f), calls=1) for f in cf_times}
    single = CoPoNeRF(dataclasses.replace(cfg, coarse_samples=0, fine_samples=0), image_size=IMAGE).eval()
    single.load_state_dict(model.state_dict())
    single = single.to(dev)
    del model, state
    with torch.no_grad():
        sstate = single.encode(batch)

        def render_single(fusion):
            for lo in range(0, IMAGE * IMAGE, CHUNK):
                q = dict(batch["query"], uv=batch["query"]["uv"][:, :, lo: lo + CHUNK],
                         rgb=batch["query"]["rgb"][:, :, lo: lo + CHUNK])
                single.render({"context": batch["context"], "query": q}, sstate, val=True, fusion=fusion)

        render_single(None)
        render_single("render_core")
        times = {None: [], "render_core": []}
        for r in range(3):               # in turns, the order reversed every other round
            for fusion in ((None, "render_core") if r % 2 == 0 else ("render_core", None)):
                times[fusion].append(host_ms(lambda: render_single(fusion), reps=1))
    del sstate
    item = ({k: {kk: vv[0] for kk, vv in v.items()} for k, v in b.items()}, {k: v[0] for k, v in g.items()},
            np.float32(1.0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # no LPIPS weights: the column is absent
        eval_ms = host_ms(lambda: evaluate(single, [item], batch_size=1, chunk=CHUNK, image_size=IMAGE,
                                           verbose=False))
        del single
        exact = init_weights(CoPoNeRF(ModelConfig(fast_sampling=False, compute_dtype="float32"),
                                      image_size=IMAGE).eval(), seed=0).to(dev)
        exact_ms = host_ms(lambda: evaluate(exact, [item], batch_size=1, chunk=4096, image_size=IMAGE,
                                            verbose=False), reps=1)
    return {"render_cf16_4_ms": statistics.median(cf_times[None]),
            "render_cf16_4_attn_embed_ms": statistics.median(cf_times["attn_embed"]),
            "render_cf16_4_turns_ms": {str(f): t for f, t in cf_times.items()},
            "render_cf16_4_kernel_ms": cf_kernel_ms,
            "render_single_stage_ms": statistics.median(times[None]),
            "render_core_single_stage_ms": statistics.median(times["render_core"]),
            "eval_single_stage_ms": eval_ms, "eval_exact_ms": exact_ms}


def time_train_step(dev, n_steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
    from coponerf_tpu_torch.data.synthetic import make_batch
    from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
    from coponerf_tpu_torch.training import trainer
    from coponerf_tpu_torch.utils.init import init_weights

    cfg = Config(model=ModelConfig(fast_sampling=True, compute_dtype="bfloat16"),
                 loss=LossConfig(pose=True, cycle=True, ssim=True), train=TrainConfig())
    state = trainer.create_train_state(cfg, IMAGE, dev,
                                       model=init_weights(CoPoNeRF(cfg.model, image_size=IMAGE), seed=0))
    batches = [batch_to_torch(make_batch(batch_size=6, image_size=IMAGE, n_rays=TRAIN_RAYS, seed=s)[0], dev)
               for s in (1, 2)]
    times = []
    for i in range(n_steps + 2):          # two warm-up steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(state, batches[i % 2], cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batches[0], cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    sampler = [e for e in kernels if SAMPLER_KERNEL in e.key]
    adam_state_leaves = len(state.optimizer.state)
    return {"step_ms": times[2:], "median_step_ms": statistics.median(times[2:]),
            "device_kernel_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "sampler_kernel_ms": sum(e.self_device_time_total for e in sampler) / 1e3,
            "sampler_launches": sum(e.count for e in sampler),
            "adam_state_leaves": adam_state_leaves, "leaves": reached_leaves(state, batches[0], cfg)}


def reached_leaves(state, batch, cfg) -> dict:
    """One forward and backward of the train step: the parameters (count,
    values) in all, those no loss reaches (``grad`` None) and the rest."""
    from coponerf_tpu_torch.training.losses import lf_loss

    model = state.model
    out = model(batch, val=False, train=True)
    losses, _ = lf_loss(cfg.loss, batch, out, batch["query"])
    state.optimizer.zero_grad(set_to_none=True)
    sum(losses.values()).backward()
    named = list(model.named_parameters())
    gradless = [(k, p) for k, p in named if p.grad is None]
    state.optimizer.zero_grad(set_to_none=True)
    size = lambda ps: sum(p.numel() for _, p in ps)
    return {"all": [len(named), size(named)], "gradless": [len(gradless), size(gradless)],
            "reached": [len(named) - len(gradless), size(named) - size(gradless)],
            "gradless_names": [k for k, _ in gradless]}


def time_dp_step(dev, n_steps: int) -> dict:
    import tempfile

    import torch.distributed as dist

    from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
    from coponerf_tpu_torch.data.synthetic import make_batch
    from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
    from coponerf_tpu_torch.parallel.mesh import average_gradients, init_distributed, make_mesh
    from coponerf_tpu_torch.training import trainer
    from coponerf_tpu_torch.utils.init import init_weights

    cfg = Config(model=ModelConfig(fast_sampling=True, compute_dtype="bfloat16"),
                 loss=LossConfig(pose=True, cycle=True, ssim=True), train=TrainConfig())
    weights = init_weights(CoPoNeRF(cfg.model, image_size=IMAGE), seed=0).state_dict()
    batch = batch_to_torch(make_batch(batch_size=6, image_size=IMAGE, n_rays=TRAIN_RAYS, seed=1)[0], dev)
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("nccl", 0, 1, f"file://{tmp}/rendezvous", device=dev)
        try:
            mesh = make_mesh()
            states = {}
            for path in ("plain", "dp"):
                model = CoPoNeRF(cfg.model, image_size=IMAGE)
                model.load_state_dict(weights)
                states[path] = trainer.create_train_state(cfg, IMAGE, dev, model=model)
            times = {p: [] for p in states}
            for i in range(n_steps + 2):          # two warm-up steps
                for path in (("plain", "dp") if i % 2 == 0 else ("dp", "plain")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.train_step(states[path], batch, cfg, mesh=mesh if path == "dp" else None)
                    torch.cuda.synchronize()
                    times[path].append((time.perf_counter() - t0) * 1e3)
            leaves = reached_leaves(states["plain"], batch, cfg)
            gradless = set(leaves["gradless_names"])
            named = list(states["dp"].model.named_parameters())
            all_reduce = {}
            for which, params in (("reached", [p for k, p in named if k not in gradless]),
                                  ("all", [p for _, p in named])):
                grads = [torch.randn_like(p) for p in params]
                all_reduce[which] = {"MiB": sum(g.numel() * 4 for g in grads) / 2 ** 20,
                                     "ms": cuda_ms_in_turns([lambda: average_gradients(mesh, grads)],
                                                            reps=5, inner=3)[0]}
                del grads
            del states
        finally:
            dist.destroy_process_group()
    return {"plain_step_ms": times["plain"][2:], "dp_step_ms": times["dp"][2:],
            "median_plain_ms": statistics.median(times["plain"][2:]),
            "median_dp_ms": statistics.median(times["dp"][2:]), "all_reduce": all_reduce}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5, help="timed train steps (after two warm-up steps)")
    ap.add_argument("--only", nargs="+", choices=SECTIONS, help="run these sections alone (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    from coponerf_tpu_torch.ops import _build

    _build.lib()
    only = set(args.only or SECTIONS)
    result = {"device": torch.cuda.get_device_name(0)}
    steps = (("samplers", lambda: result.update(time_samplers(dev))),
             ("k4", lambda: result.update(train_k4=time_k4(dev))),
             ("attn_embed", lambda: result.update(attn_embed=time_attn_embed(dev))),
             ("split_dense", lambda: result.update(split_dense_relu=time_split_dense(dev))),
             ("render_core", lambda: result.update(time_render_core(dev))),
             ("k5", lambda: result.update(k5=time_k5(dev))),
             ("render_eval", lambda: result.update(time_render_and_eval(dev))),
             ("train_step", lambda: result.update(train_step=time_train_step(dev, args.steps))),
             ("dp_step", lambda: result.update(dp_step=time_dp_step(dev, args.steps))))
    for name, step in steps:
        if name in only:
            step()
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
