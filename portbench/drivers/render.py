"""Render traffic: one client in a closed loop, each request one whole image.

Parameters (``portbench/traffic/<mix>.json``):
  pool                stereo pairs made in set-up from the seed, used in turn
  frames_per_scene    1: each request encodes its pair and renders the pair's
                      query view (evaluation); n > 1: a camera path of n
                      frames between the pair's two context cameras, one
                      encode a path, charged to its first frame
  chunk               rays a ``render`` call (``make_renderer``'s chunk)
  warmup_requests     requests before the window, in set-up
  trace_requests      requests under the profiler in a traced run, after the window
  compare_requests    requests of the window compared with the reference
  reference_chunk     rays a reference ``render`` call

The timed path is the port's own: ``eval.harness.make_renderer(model,
chunk)``'s ``encode`` and ``render_image``, with the keys the ``test`` entry
takes (rgb, depth_ray, at_wt).  A request ends when its rgb is on the host.
It fails on an exception, a non-finite rgb or attention weight, or weights
that do not sum to 1 over views x samples.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import devtrace, scenes
from portbench.harness import Context, Outcome
from portbench.weights import load_weights

_MAX_WSUM_ERR = 1e-3


def make_model(ctx: Context):
    """The program: the port's model at the cell's configuration, its
    weights drawn from the seed."""
    from coponerf_tpu_torch.config import ModelConfig
    from coponerf_tpu_torch.models import CoPoNeRF

    model = CoPoNeRF(ModelConfig(**ctx.config["model"]), image_size=ctx.config["image_size"])
    return load_weights(model, ctx.seed, ctx.device).eval()


def make_renderer(model, chunk: int):
    from coponerf_tpu_torch.eval.harness import make_renderer as port_renderer

    return port_renderer(model, chunk=chunk)


def reference_model(ctx: Context):
    """The plain reference at the cell's configuration in f32, the same weights."""
    from portbench.reference.config import ModelConfig
    from portbench.reference.models import CoPoNeRF

    fields = dict(ctx.config["model"], compute_dtype="float32")
    model = CoPoNeRF(ModelConfig(**fields), image_size=ctx.config["image_size"])
    return load_weights(model, ctx.seed, ctx.device).eval()


class Traffic:
    """The pool of pairs and, for paths, each pair's poses; request ``i``'s
    pair, frame and batch."""

    def __init__(self, ctx: Context):
        tr = ctx.traffic
        size, self.pool, self.frames = ctx.config["image_size"], tr["pool"], tr["frames_per_scene"]
        self.n_rays = size * size
        self.pairs = [scenes.make_batch(ctx.seed, [i], size, self.n_rays, ctx.device, full_query_image=True)
                      for i in range(self.pool)]
        self.poses = None
        if self.frames > 1:
            self.poses = [torch.as_tensor(scenes.interpolate_poses(*p["context"]["cam2world"][0].cpu().numpy(),
                                                                   self.frames), device=ctx.device)
                          for p in self.pairs]

    def where(self, i: int):
        """(pair, frame) of request ``i``."""
        return (i // self.frames) % self.pool, i % self.frames

    def batch(self, i: int):
        s, f = self.where(i)
        return self.pairs[s] if self.poses is None else scenes.path_batch(self.pairs[s], self.poses[s][f])


def _request(encode, render_image, traffic: Traffic, i: int, scene: Dict[str, Any]):
    """Request ``i``: encode at a pair's first frame, render the view, bring
    rgb and the weights' check to the host.  Returns (rgb on the host, the
    render's outputs, the encode state, the check's numbers)."""
    s, f = traffic.where(i)
    if f == 0 or scene.get("s") != s:
        scene["state"], scene["s"] = encode(traffic.pairs[s]), s
    out = render_image(traffic.batch(i), scene["state"], traffic.n_rays)
    at = out["at_wt"]
    wsum = at.reshape(1, 2, traffic.n_rays, -1).sum(dim=(1, 3))
    tail = torch.stack([(wsum - 1).abs().max(), torch.isfinite(at).all().float()])
    host = torch.cat([out["rgb"].reshape(-1).float(), tail.float()]).cpu()
    return host[:-2], out, scene["state"], host[-2:]


def _ok(rgb: torch.Tensor, tail: torch.Tensor) -> bool:
    return bool(torch.isfinite(rgb).all()) and float(tail[1]) == 1.0 and float(tail[0]) <= _MAX_WSUM_ERR


def run(ctx: Context) -> Outcome:
    tr = ctx.traffic
    dev = ctx.device
    model = make_model(ctx)
    ctx.log(f"set-up: model at {time.perf_counter() - ctx.t0:.3f} s")
    traffic = Traffic(ctx)
    encode, render_image = make_renderer(model, tr["chunk"])
    scene: Dict[str, Any] = {}
    for i in range(tr["warmup_requests"]):
        rgb, _, _, tail = _request(encode, render_image, traffic, i, scene)
        if not _ok(rgb, tail):
            raise RuntimeError(f"warm-up request {i} failed its check")
        ctx.log(f"set-up: warm-up request {i} done at {time.perf_counter() - ctx.t0:.3f} s")
    scene.clear()
    sync(dev)
    enc_ms: List[float] = []
    ren_ms: List[float] = []
    plain = (encode, render_image)
    if ctx.trace:   # spans around each encode and each render_image, by CUDA events
        encode, render_image = _spans(encode, enc_ms, dev), _spans(render_image, ren_ms, dev)

    # the requests compared: a uniform sample of those completed, by
    # reservoir from the seed; holding references costs the window nothing
    rng = np.random.default_rng([ctx.seed % (2 ** 63), 1])
    k = tr["compare_requests"]
    kept: List[Dict[str, Any]] = []
    lat: List[float] = []
    failed = done = 0
    setup_s = time.perf_counter() - ctx.t0
    t_w0 = time.perf_counter()
    deadline = t_w0 + ctx.seconds
    i, t_end = 0, t_w0
    while t_end < deadline:
        ts = time.perf_counter()
        try:
            rgb, out, state, tail = _request(encode, render_image, traffic, i, scene)
            ok = _ok(rgb, tail)
        except Exception as exc:    # a failed request counts; the loop goes on
            ctx.log(f"request {i} failed: {exc!r}")
            ok = False
        t_end = time.perf_counter()
        lat.append(t_end - ts)
        if not ok:
            failed += 1
        else:
            item = {"i": i, "rgb": rgb, "at_wt": out["at_wt"], "state": state}
            done += 1
            if len(kept) < k:
                kept.append(item)
            else:
                j = int(rng.integers(0, done))
                if j < k:
                    kept[j] = item
        i += 1
    window_s = t_end - t_w0
    n_req = i
    for fn in (encode, render_image):
        getattr(fn, "drain", lambda: None)()
    n_enc = sum(1 for j in range(n_req) if traffic.where(j)[1] == 0)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    rec: Dict[str, Any] = {
        "setup_s": setup_s, "window_s": window_s, "latencies_s": lat, "images": n_req - failed,
        "requests": n_req, "encodes": n_enc, "encode_ms": enc_ms, "render_ms": ren_ms,
        "config": ctx.config, "traffic": tr, "device": dev,
    }
    breakdown = None
    if ctx.trace:
        rec["profile"] = _profile(*plain, traffic, tr["trace_requests"], n_req, dev)
        breakdown = {"device_ops": rec["profile"]["device_ops"], "idle_gaps": rec["profile"]["idle_gaps"]}
    ctx.log(f"window: {n_req} requests ({failed} failed) in {window_s:.3f} s; setup {setup_s:.3f} s; "
            f"peak {peak} bytes")

    # free the program before the reference runs
    del model, encode, render_image, plain
    out = state = None
    scene.clear()
    checks = compare(ctx, traffic, kept)
    return Outcome(attempted=n_req, failed=failed, rec=rec, checks=checks, memory_peak_bytes=peak,
                   breakdown=breakdown)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _spans(fn, sink: List[float], dev):
    """``fn`` with its device time recorded into ``sink`` (ms), by CUDA
    events read after the window."""
    if dev.type != "cuda":
        def timed_cpu(*a, **kw):
            t = time.perf_counter()
            r = fn(*a, **kw)
            sink.append((time.perf_counter() - t) * 1e3)
            return r
        return timed_cpu
    pending = []

    def timed(*a, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        r = fn(*a, **kw)
        e1.record()
        pending.append((e0, e1))
        return r

    def drain():
        torch.cuda.synchronize(dev)
        sink.extend(a.elapsed_time(b) for a, b in pending)
        pending.clear()
    timed.drain = drain
    return timed


def _profile(encode, render_image, traffic: Traffic, n: int, first: int, dev) -> Dict:
    """``n`` more requests under ``torch.profiler``, after the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    scene: Dict[str, Any] = {}
    # the window starts at a path's first frame, so it holds whole paths' encodes
    start = -(-first // traffic.frames) * traffic.frames
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            for i in range(start, start + n):
                _request(encode, render_image, traffic, i, scene)
        sync(dev)
    red = devtrace.reduce_profile(prof)
    red["requests"] = n
    red["encodes"] = sum(1 for j in range(start, start + n) if traffic.where(j)[1] == 0)
    return red


def _chunk_query(batch, a: int, b: int):
    q = dict(batch["query"])
    q["uv"] = batch["query"]["uv"][:, :, a:b]
    q["rgb"] = batch["query"]["rgb"][:, :, a:b]
    return {"context": batch["context"], "query": q}


@torch.no_grad()
def reference_render(ref, batch, state, n_rays: int, chunk: int):
    """The reference's rgb (n_rays, 3) and at_wt of one view from ``state``."""
    rgb, at = [], []
    for a in range(0, n_rays, chunk):
        out = ref.render(_chunk_query(batch, a, min(a + chunk, n_rays)), state, val=True)
        rgb.append(out["rgb"].reshape(-1, 3))
        at.append(out["at_wt"])
    return torch.cat(rgb), torch.cat(at, dim=1)


class Gaps:
    """Sums for relative RMS gaps and the gaps' distribution."""

    def __init__(self):
        self.sums, self.abs = {}, {}

    def add(self, name: str, prog: torch.Tensor, ref: torch.Tensor) -> None:
        d = prog.float().reshape(-1) - ref.float().reshape(-1)
        a, b = self.sums.get(name, (0.0, 0.0))
        self.sums[name] = (a + float((d * d).sum()), b + float((ref.float() ** 2).sum()))
        self.abs.setdefault(name, []).append(d.abs().cpu())

    def rel_rms(self, name: str) -> float:
        a, b = self.sums[name]
        return float(np.sqrt(a / max(b, 1e-30)))

    def quantile(self, name: str, q: float) -> float:
        x = torch.cat(self.abs[name])
        return float(torch.quantile(x[torch.randperm(len(x))[:1_000_000]], q)) if len(x) else 0.0


def compare(ctx: Context, traffic: Traffic, kept: List[Dict[str, Any]],
            detail: Dict[str, float] | None = None) -> Dict[str, float]:
    """The kept requests against the plain reference, run after the window
    in f32 with TF32 off.  The reference encodes each request's pair
    itself; it renders the view from its own latents and flows but the
    program's relative pose, which the render's second hypothesis is built
    on (at random weights the pose head turns the bf16 rounding of its
    inputs into pose gaps as large as the fp8 control's, so the pose is
    not compared; ``PERF.md``):
      rgb_rel_rms    RMS of the rgb gap over every pixel, over the reference's RMS
      at_wt_l1       mean over rays of the attention weights' L1 gap (views x samples)
      z_rel_rms      RMS of the four latent tables' gap over the reference's RMS
      flow_rel_rms   RMS of both flows' gap over the reference's RMS
    ``detail`` (calibration) also gets the pose gap, the same rgb numbers
    from the reference's own pose and the gaps' quantiles."""
    inf = float("inf")
    if not kept:
        return {"rgb_rel_rms": inf, "at_wt_l1": inf, "z_rel_rms": inf, "flow_rel_rms": inf}
    dev = ctx.device
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    g = Gaps()
    l1 = {"follow": 0.0, "own": 0.0}
    rays, pose = 0, 0.0
    try:
        ref = reference_model(ctx)
        t = time.perf_counter()
        for item in sorted(kept, key=lambda it: it["i"]):
            batch, ps = traffic.batch(item["i"]), item["state"]
            with torch.no_grad():
                state = ref.encode(batch, train=False)
            pose = max(pose, float((ps.rel_pose[:, :3, :4].float() - state.rel_pose[:, :3, :4]).abs().max()))
            for fp, fr in zip(ps.flows[:2], state.flows[:2]):
                g.add("flow", fp, fr)
            for zp, zr in zip(ps.z, state.z):
                g.add("z", zp, zr)
            variants = [("follow", dataclasses.replace(state, rel_pose=ps.rel_pose.float()))]
            if detail is not None:
                variants.append(("own", state))
            for name, st in variants:
                rgb_r, at_r = reference_render(ref, batch, st, traffic.n_rays, ctx.traffic["reference_chunk"])
                g.add("rgb_" + name, item["rgb"].to(dev), rgb_r)
                per_ray = (item["at_wt"].float() - at_r).abs().reshape(2, traffic.n_rays, -1).sum(dim=(0, 2))
                l1[name] += float(per_ray.sum())
            rays += traffic.n_rays
        sync(dev)
        ctx.log(f"reference: {len(kept)} requests in {time.perf_counter() - t:.3f} s")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if detail is not None:
        detail.update(pose_abs=pose, rgb_rel_rms_own=g.rel_rms("rgb_own"), at_wt_l1_own=l1["own"] / rays)
        for name in ("rgb_follow", "rgb_own"):
            for q in (0.5, 0.9, 0.99):
                detail[f"{name}_abs_q{q}"] = g.quantile(name, q)
    ctx.log(f"not compared: pose_abs {pose!r}")
    return {"rgb_rel_rms": g.rel_rms("rgb_follow"), "at_wt_l1": l1["follow"] / rays, "z_rel_rms": g.rel_rms("z"),
            "flow_rel_rms": g.rel_rms("flow")}
