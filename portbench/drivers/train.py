"""Training traffic: back-to-back ``train_step``s of the port on batches of
stereo pairs.

Parameters (``portbench/traffic/<mix>.json``):
  batch           pairs a step
  rays            query rays a pair
  pool            batches made in set-up from the seed, used in turn; every
                  pair of the pool is a different scene
  compare_steps   the first steps, taken in set-up through the window's own
                  call and feed, that the reference follows
  trace_steps     steps under the profiler in a traced run, after the window

Set-up builds one train state (``training.trainer.create_train_state``) and
drives it through ``compare_steps`` steps, reading what the comparison
needs; the window then steps that same state on.  A step ends when its
loss is on the host.  It fails on an exception, a non-finite loss or a step
that applied no update (``notfinite_count``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import devtrace, scenes
from portbench.harness import Context, Outcome
from portbench.weights import draw_state_dict, load_weights


def _tuples(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def make_cfg(ctx: Context):
    from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig

    c = ctx.config
    return Config(model=ModelConfig(**_tuples(c["model"])), loss=LossConfig(**c["loss"]),
                  train=TrainConfig(**_tuples(c["train"])))


def make_state(ctx: Context, cfg):
    """The program: the port's model and train state, weights from the seed."""
    from coponerf_tpu_torch.models import CoPoNeRF
    from coponerf_tpu_torch.training.trainer import create_train_state

    model = load_weights(CoPoNeRF(cfg.model, image_size=ctx.config["image_size"]), ctx.seed, ctx.device)
    return create_train_state(cfg, ctx.config["image_size"], ctx.device, model=model)


def step(state, batch, cfg) -> Dict[str, torch.Tensor]:
    from coponerf_tpu_torch.training.trainer import train_step

    return train_step(state, batch, cfg)


def _step(state, batch, cfg, terms=None):
    """One step; (its total loss on the host, whether it counts as done).
    ``terms`` gets each loss term's value."""
    before = state.updates
    m = step(state, batch, cfg)
    loss = float(m["total_train_loss"])
    if terms is not None:
        terms.append({k: float(v) for k, v in m.items() if k.endswith("_loss") or k == "grad_norm"})
    return loss, bool(np.isfinite(loss)) and state.notfinite_count == 0 and state.updates == before + 1


def prepare(ctx: Context):
    """Set-up: the train state, the pool of batches and the first steps.
    Returns (cfg, state, batches, the steps' losses, the first gradient's
    norm by parameter as Adam got it, the change's norm by parameter)."""
    tr = ctx.traffic
    dev = ctx.device
    B, size = tr["batch"], ctx.config["image_size"]
    cfg = make_cfg(ctx)
    state = make_state(ctx, cfg)
    ctx.log(f"set-up: state at {time.perf_counter() - ctx.t0:.3f} s")
    batches = [scenes.make_batch(ctx.seed, list(range(b * B, (b + 1) * B)), size, tr["rays"], dev)
               for b in range(tr["pool"])]
    n_cmp = tr["compare_steps"]
    if n_cmp > tr["pool"]:
        raise ValueError("the compared steps need a batch each")
    named = list(state.model.named_parameters())
    losses, terms, grad1 = [], [], {}
    for s in range(n_cmp):
        loss, ok = _step(state, batches[s], cfg, terms)
        if not ok:
            raise RuntimeError(f"set-up step {s} failed: loss {loss}")
        losses.append(loss)
        ctx.log(f"set-up: step {s} done at {time.perf_counter() - ctx.t0:.3f} s")
        if s == 0:      # Adam's first moment after one step is (1 - b1) * the gradient it got
            b1 = state.optimizer.param_groups[0]["betas"][0]
            grad1 = {n: float(state.optimizer.state[p]["exp_avg"].norm()) / (1 - b1) if p in state.optimizer.state
                     else 0.0 for n, p in named}
    start = draw_state_dict(state.model, ctx.seed, dev)
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named}
    return cfg, state, batches, (losses, terms), grad1, change


def run(ctx: Context) -> Outcome:
    tr = ctx.traffic
    dev = ctx.device
    B = tr["batch"]
    n_cmp = tr["compare_steps"]
    cfg, state, batches, losses, grad1, change = prepare(ctx)
    sync(dev)

    lat: List[float] = []
    failed = 0
    setup_s = time.perf_counter() - ctx.t0
    t_w0 = time.perf_counter()
    deadline = t_w0 + ctx.seconds
    i, t_end = n_cmp, t_w0
    while t_end < deadline:
        ts = time.perf_counter()
        try:
            _, ok = _step(state, batches[i % tr["pool"]], cfg)
        except Exception as exc:    # a failed step counts; the loop goes on
            ctx.log(f"step {i} failed: {exc!r}")
            ok = False
        t_end = time.perf_counter()
        lat.append(t_end - ts)
        failed += not ok
        i += 1
    window_s = t_end - t_w0
    n_steps = i - n_cmp
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec: Dict[str, Any] = {
        "setup_s": setup_s, "window_s": window_s, "latencies_s": lat, "steps": n_steps,
        "pairs": (n_steps - failed) * B, "config": ctx.config, "traffic": tr, "device": dev,
    }
    breakdown = None
    if ctx.trace:
        rec["profile"] = _profile(state, batches, cfg, i, tr["trace_steps"], dev)
        breakdown = {"device_ops": rec["profile"]["device_ops"], "idle_gaps": rec["profile"]["idle_gaps"]}
    ctx.log(f"window: {n_steps} steps ({failed} failed) in {window_s:.3f} s; setup {setup_s:.3f} s; "
            f"peak {peak} bytes; set-up losses {losses[0]}")

    del state      # free the program before the reference runs
    checks = compare(ctx, cfg, batches[:n_cmp], losses, grad1, change)
    return Outcome(attempted=n_steps, failed=failed, rec=rec, checks=checks, memory_peak_bytes=peak,
                   breakdown=breakdown)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile(state, batches, cfg, first: int, n: int, dev) -> Dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            for i in range(first, first + n):
                _step(state, batches[i % len(batches)], cfg)
        sync(dev)
    red = devtrace.reduce_profile(prof)
    red["steps"] = n
    red["pairs"] = n * batches[0]["query"]["uv"].shape[0]
    return red


def reference_model(ctx: Context):
    from portbench.reference.config import ModelConfig
    from portbench.reference.models import CoPoNeRF

    fields = dict(_tuples(ctx.config["model"]), compute_dtype="float32")
    return load_weights(CoPoNeRF(ModelConfig(**fields), image_size=ctx.config["image_size"]), ctx.seed, ctx.device)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    """Each leaf's gap between the program's and the reference's norm, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def compare(ctx: Context, cfg, batches, losses, grad1, change,
            detail: Dict[str, Any] | None = None) -> Dict[str, float]:
    """The first steps against the plain reference's, in f32 with TF32 off:
      ssim1_rel           relative gap of the first step's SSIM loss term
      change3_median_gap  the median leaf's gap (``leaf_gaps``) of the
                          parameters' change over the steps, over the leaves
                          whose reference gradient is at least a thousandth
                          of the median leaf's (the others move by round-off
                          under Adam)
    At random weights the pose term's gradient swings by factors on a
    half-ulp change of its input, and through the global-norm clip and
    Adam's first steps it moves every later loss, every leaf's first
    gradient and the small leaves' changes (``PERF.md``): those, each step's
    loss, the worst leaves and every first-step term are logged, not
    compared.  ``detail`` (calibration) gets them too."""
    from portbench.reference.config import LossConfig
    from portbench.reference.train import train_steps

    dev = ctx.device
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        t = time.perf_counter()
        ref = reference_model(ctx)
        (r_losses, r_terms), r_grad1, r_change = train_steps(ref, batches, LossConfig(**dataclasses.asdict(cfg.loss)),
                                                  cfg.train.lr, cfg.train.clip_grad_norm)
        sync(dev)
        ctx.log(f"reference: {len(batches)} steps in {time.perf_counter() - t:.3f} s; losses {r_losses}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    names = list(r_grad1)
    med = float(np.median([r_grad1[n] for n in names]))
    moved = [n for n in names if r_grad1[n] >= 1e-3 * med]
    losses, terms = losses
    step_gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, r_losses)]
    term_gaps = [{k: abs(t[k] - r[k]) / max(abs(r[k]), 1e-30) for k in r} for t, r in zip(terms, r_terms)]
    g1, d3 = leaf_gaps(grad1, r_grad1, names), leaf_gaps(change, r_change, moved)
    ctx.log(f"not compared: loss gaps by step {step_gaps!r}; first-step terms {term_gaps[0]!r}; "
            f"grad1 worst leaf {max(g1.values())!r}, median leaf {float(np.median(list(g1.values()))):.6g}; "
            f"change3 worst leaf {max(d3.values())!r}")
    if detail is not None:
        detail.update(losses=losses, ref_losses=r_losses, step_gaps=step_gaps, terms=terms, ref_terms=r_terms,
                      term_gaps=term_gaps, grad1_leaf_gap=max(g1.values()), change3_leaf_gap=max(d3.values()),
                      grad1_median_gap=float(np.median(list(g1.values()))),
                      change3_median_gap=float(np.median(list(d3.values()))),
                      grad1_worst=sorted(g1.items(), key=lambda kv: -kv[1])[:6],
                      change3_worst=sorted(d3.items(), key=lambda kv: -kv[1])[:6],
                      leaves=len(names), moved=len(moved),
                      grad1_norms=[(n, grad1[n], r_grad1[n]) for n, _ in sorted(g1.items(), key=lambda kv: -kv[1])[:6]])
    return {"ssim1_rel": term_gaps[0]["ssim_loss"], "change3_median_gap": float(np.median(list(d3.values())))}
