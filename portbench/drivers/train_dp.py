"""Data-parallel training traffic: ``train --gpus N``'s step, back to back,
on N ranks of one machine, each its own process on its own card (NCCL;
gloo on a CPU).

Parameters (``portbench/traffic/<mix>.json``):
  ranks           processes, one card each
  batch           pairs a global step; each rank holds batch / ranks of them
  rays            query rays a pair
  pool            global batches made in set-up from the seed, used in turn;
                  each rank makes only its share (the same pairs that
                  ``parallel.mesh.shard_batch`` would cut from the global batch)
  compare_steps   the first steps, taken in set-up, that the reference follows
  trace_steps     steps in a traced run after the window: that many with the
                  program's spans on (``trace.collecting()``) on every rank,
                  then that many with every rank under the profiler

Each rank builds the train state from the seed, takes rank 0's weights
(``parallel.mesh.replicate``, as ``train`` does) and steps with
``train_step(..., mesh=...)``: BatchNorm over the global batch, the losses'
global normalisers, one flat gradient all-reduce.  A step ends when its
loss is on rank 0's host; rank 0 then tells every rank whether the window
goes on (one broadcast outside the step).  The reference is the plain one
on the same ranks and shares (``reference/dist.py``), after the window.
"""

from __future__ import annotations

import dataclasses
import socket
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import devtrace, scenes
from portbench.drivers import train as single
from portbench.harness import Context, Outcome
from portbench.weights import draw_state_dict


def run(ctx: Context, mode: str = "program", seeds: List[int] | None = None):
    """One run of the cell.  ``mode`` and ``seeds`` are the calibration's
    (``calibrate_dp.py``): several seeds in one launch of the ranks, the
    program, the control or the fault in the program's place; the
    calibration then gets each seed's readings."""
    from coponerf_tpu_torch.parallel.launch import run_ranks

    world = ctx.traffic["ranks"]
    cuda = ctx.device.type == "cuda"
    with socket.socket() as s:     # a free port for the group's rendezvous
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    job = {"ctx": ctx, "mode": mode, "seeds": seeds or [ctx.seed],
           "t0_wall": time.time() - (time.perf_counter() - ctx.t0)}
    outs = run_ranks(_rank, world, "nccl" if cuda else "gloo", f"tcp://localhost:{port}", args=(job,),
                     devices=[torch.device("cuda", r) for r in range(world)] if cuda else None,
                     threads=None if cuda else 2, deadline_s=1200 + ctx.seconds)
    peak = max(o["peak"] for o in outs)
    if seeds is not None:
        return outs[0]["seeds"]
    r0 = outs[0]["seeds"][0]
    rec = dict(r0["rec"], config=ctx.config, traffic=ctx.traffic, device=ctx.device)
    breakdown = None
    if ctx.trace:
        breakdown = {"device_ops": rec["profile"]["device_ops"], "idle_gaps": rec["profile"]["idle_gaps"]}
    ctx.log(f"window: {rec['steps']} steps ({r0['failed']} failed) in {rec['window_s']:.3f} s; "
            f"setup {rec['setup_s']:.3f} s; peak {peak} bytes; set-up losses {r0['prog']['losses']}")
    checks = compare(ctx, r0["prog"], r0["ref"])
    return Outcome(attempted=rec["steps"], failed=r0["failed"], rec=rec, checks=checks, memory_peak_bytes=peak,
                   breakdown=breakdown)


def _rank(rank: int, world: int, job: Dict[str, Any]) -> Dict[str, Any]:
    from coponerf_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", rank) if job["ctx"].device.type == "cuda" else torch.device("cpu")
    mesh = make_mesh()
    if job["mode"] == "rank_short":     # the fault: the averages over the ranks count one rank short
        mesh = dataclasses.replace(mesh, world_size=world - 1)
    if job["mode"] == "no_allreduce":   # the fault: each rank steps on its own share's gradient
        from coponerf_tpu_torch.training import trainer
        trainer.average_gradients = lambda mesh, grads: None
    log = job["ctx"].log if rank == 0 else (lambda *a: None)
    out = []
    for seed in job["seeds"]:
        ctx = dataclasses.replace(job["ctx"], seed=seed, device=dev, log=log)
        out.append(_one(ctx, mesh, job))
    return {"peak": max(o["peak"] for o in out), "seeds": out if rank == 0 else []}


def _state(ctx: Context, cfg, mode: str):
    """The program, or in the control's place the plain reference with the
    global batch's BatchNorm, every product in fp8 (``control.py``)."""
    if mode != "control":
        return single.make_state(ctx, cfg)
    from coponerf_tpu_torch.training.trainer import create_train_state

    from portbench.control import fp8_model
    from portbench.reference.dist import global_batch_norm

    model = fp8_model(global_batch_norm(single.reference_model(ctx)))
    return create_train_state(cfg, ctx.config["image_size"], ctx.device, model=model)


def _step(state, batch, cfg, mesh, terms=None):
    """As ``train._step``, under the mesh; the metrics are the global batch's."""
    from coponerf_tpu_torch.training.trainer import train_step

    before = state.updates
    m = train_step(state, batch, cfg, mesh=mesh)
    loss = float(m["total_train_loss"])
    if terms is not None:
        terms.append({k: float(v) for k, v in m.items() if k.endswith("_loss") or k == "grad_norm"})
    return loss, bool(np.isfinite(loss)) and state.notfinite_count == 0 and state.updates == before + 1


def _one(ctx: Context, mesh, job: Dict[str, Any]) -> Dict[str, Any]:
    """Set-up, the window, the traced steps and the reference, for one seed."""
    import torch.distributed as dist

    from coponerf_tpu_torch.parallel.mesh import replicate

    tr, dev, rank, world = ctx.traffic, ctx.device, dist.get_rank(), dist.get_world_size()
    G, size = tr["batch"], ctx.config["image_size"]
    B = G // world
    cfg = single.make_cfg(ctx)
    state = _state(ctx, cfg, job["mode"])
    replicate(mesh, state.model)
    ctx.log(f"set-up: state at {time.time() - job['t0_wall']:.3f} s")
    batches = [scenes.make_batch(ctx.seed, list(range(b * G + rank * B, b * G + (rank + 1) * B)), size, tr["rays"],
                                 dev) for b in range(tr["pool"])]
    n_cmp = tr["compare_steps"]
    named = list(state.model.named_parameters())
    losses, terms, grad1 = [], [], {}
    for s in range(n_cmp):
        loss, ok = _step(state, batches[s], cfg, mesh, terms)
        if not ok:
            raise RuntimeError(f"set-up step {s} failed: loss {loss}")
        losses.append(loss)
        ctx.log(f"set-up: step {s} done at {time.time() - job['t0_wall']:.3f} s")
        if s == 0:      # Adam's first moment after one step is (1 - b1) * the gradient it got
            b1 = state.optimizer.param_groups[0]["betas"][0]
            grad1 = {n: float(state.optimizer.state[p]["exp_avg"].norm()) / (1 - b1) if p in state.optimizer.state
                     else 0.0 for n, p in named}
    start = draw_state_dict(state.model, ctx.seed, dev)
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named}
    del start
    ranks_gap = _ranks_gap([p for _, p in named], change)
    single.sync(dev)

    go = torch.ones(1, dtype=torch.int32, device=dev)
    lat: List[float] = []
    failed = 0
    setup_s = time.time() - job["t0_wall"]
    t_w0 = time.perf_counter()
    deadline = t_w0 + ctx.seconds
    i, t_end = n_cmp, t_w0
    while True:
        ts = time.perf_counter()
        _, ok = _step(state, batches[i % tr["pool"]], cfg, mesh)
        t_end = time.perf_counter()
        lat.append(t_end - ts)
        failed += not ok
        i += 1
        go.fill_(int(t_end < deadline))
        dist.broadcast(go, src=0)
        if not int(go.item()):
            break
    window_s = t_end - t_w0
    n_steps = i - n_cmp
    rec: Dict[str, Any] = {"setup_s": setup_s, "window_s": window_s, "latencies_s": lat, "steps": n_steps,
                           "pairs": (n_steps - failed) * G}
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        steps = range(i, i + tr["trace_steps"])
        trace = _tracer()
        if trace is not None:   # the spans, every rank alike and no profiler to slow one of them
            trace.reset()
            with trace.collecting():
                for j in steps:
                    _step(state, batches[j % tr["pool"]], cfg, mesh)
                single.sync(dev)
            if rank == 0:
                rec["spans"] = trace.summary()
            trace.reset()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof, record_function(devtrace.WINDOW):     # every rank alike
            for j in steps:
                _step(state, batches[j % tr["pool"]], cfg, mesh)
            single.sync(dev)
        if rank == 0:
            rec["profile"] = dict(devtrace.reduce_profile(prof), steps=tr["trace_steps"],
                                  pairs=tr["trace_steps"] * G)
    single.sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = _reference(ctx, cfg, batches[:n_cmp])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return {"rec": rec, "failed": failed, "peak": peak, "ref": ref,
            "prog": {"losses": losses, "terms": terms, "grad1": grad1, "change": change, "ranks_gap": ranks_gap}}


def _ranks_gap(params, change: Dict[str, float]) -> float:
    """The farthest rank's distance from rank 0's parameters after the
    compared steps, over rank 0's change from the start (``change``, by
    leaf): 0 where every rank took the same updates."""
    import torch.distributed as dist

    mine = torch.cat([p.detach().reshape(-1).float() for p in params])
    rank0 = mine.clone()
    dist.broadcast(rank0, src=0)
    gap = (mine - rank0).norm().reshape(1)
    del mine, rank0
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap) / max(float(np.sqrt(sum(c * c for c in change.values()))), 1e-30)


def _tracer():
    """The program's tracer, or None in a program from before it (no spans to read)."""
    try:
        from coponerf_tpu_torch import trace
    except ImportError:
        return None
    return trace


def _reference(ctx: Context, cfg, batches) -> Dict[str, Any]:
    """The plain reference's first steps on this rank's shares, in f32 with TF32 off."""
    from portbench.reference.config import LossConfig
    from portbench.reference.dist import global_batch_norm, train_steps

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        t = time.perf_counter()
        ref = global_batch_norm(single.reference_model(ctx))
        (losses, terms), grad1, change = train_steps(ref, batches, LossConfig(**dataclasses.asdict(cfg.loss)),
                                                     cfg.train.lr, cfg.train.clip_grad_norm)
        single.sync(ctx.device)
        ctx.log(f"reference: {len(batches)} steps in {time.perf_counter() - t:.3f} s; losses {losses}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"losses": losses, "terms": terms, "grad1": grad1, "change": change}


def compare(ctx: Context, prog: Dict[str, Any], ref: Dict[str, Any],
            detail: Dict[str, Any] | None = None) -> Dict[str, float]:
    """The numbers of ``train.compare``, from the program's and the
    reference's readings on rank 0 (the losses and terms are the global
    batch's, the gradients and changes every rank's alike):
      ssim1_rel           relative gap of the first step's SSIM loss term
      change3_median_gap  the median leaf's gap of the parameters' change
                          over the steps, over the leaves whose reference
                          gradient is at least a thousandth of the median's
      ranks_param_gap     the farthest rank's distance from rank 0's
                          parameters after the steps, over rank 0's change:
                          the gradient all-reduce's, which the other two
                          numbers do not see (the first step's forward runs
                          before it; Adam's first steps hide a gradient's scale)"""
    names = list(ref["grad1"])
    med = float(np.median([ref["grad1"][n] for n in names]))
    moved = [n for n in names if ref["grad1"][n] >= 1e-3 * med]
    step_gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    term_gaps = [{k: abs(t[k] - r[k]) / max(abs(r[k]), 1e-30) for k in r} for t, r in zip(prog["terms"], ref["terms"])]
    g1 = single.leaf_gaps(prog["grad1"], ref["grad1"], names)
    d3 = single.leaf_gaps(prog["change"], ref["change"], moved)
    log = ctx.log or (lambda *a: None)
    log(f"not compared: loss gaps by step {step_gaps!r}; first-step terms {term_gaps[0]!r}; "
        f"grad1 worst leaf {max(g1.values())!r}, median leaf {float(np.median(list(g1.values()))):.6g}; "
        f"change3 worst leaf {max(d3.values())!r}")
    if detail is not None:
        detail.update(losses=prog["losses"], ref_losses=ref["losses"], step_gaps=step_gaps, terms=prog["terms"],
                      ref_terms=ref["terms"], term_gaps=term_gaps, grad1_median_gap=float(np.median(list(g1.values()))),
                      change3_median_gap=float(np.median(list(d3.values()))), leaves=len(names), moved=len(moved))
    return {"ssim1_rel": term_gaps[0]["ssim_loss"], "change3_median_gap": float(np.median(list(d3.values()))),
            "ranks_param_gap": prog["ranks_gap"]}
