"""The readings that the comparison's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 --as program|control|half_batch

For each seed, in one process, a run of the cell's driver with a short
window (``--seconds``), and the numbers it compares, with the calibration's
extra detail, as one JSON line a seed:
  program     the port as the benchmark runs it: the lower readings
  control     the plain reference in the program's place, every product in
              fp8 (``control.py``): the upper readings
  half_batch  (training) each step on the first half of its batch, its mean
              over that half: a fault the comparison has to catch
  perturbed   the plain f32 reference in the program's place, its context
              images scaled by 1 + 2^-9 (half a bf16 step): how far the
              compared numbers move on a change below bf16's rounding
The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from portbench import harness  # noqa: E402


def half(batch):
    """The batch's first half, every tensor cut on its first axis."""
    if isinstance(batch, dict):
        return {k: half(v) for k, v in batch.items()}
    return batch[: batch.shape[0] // 2]


def perturbed(batch):
    """The batch with its context images scaled by 1 + 2^-9."""
    ctx = dict(batch["context"], rgb=batch["context"]["rgb"] * (1 + 2 ** -9))
    return dict(batch, context=ctx)


def plant(driver, mode: str) -> None:
    """Put the control, the fault or the perturbed reference in the program's place."""
    import torch

    from portbench.control import fp8_model

    if mode in ("control", "perturbed"):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if mode == "perturbed" and hasattr(driver, "make_model"):
        driver.make_model = driver.reference_model
        make_renderer = driver.make_renderer

        def perturbed_renderer(model, chunk):
            encode, render_image = make_renderer(model, chunk)
            return (lambda b: encode(perturbed(b))), (lambda b, st, n: render_image(perturbed(b), st, n))
        driver.make_renderer = perturbed_renderer
        return
    if mode == "perturbed":
        def make_state(ctx, cfg):
            from coponerf_tpu_torch.training.trainer import create_train_state

            return create_train_state(cfg, ctx.config["image_size"], ctx.device, model=driver.reference_model(ctx))
        driver.make_state = make_state
        step = driver.step
        driver.step = lambda state, batch, cfg: step(state, perturbed(batch), cfg)
        return

    if mode == "control" and hasattr(driver, "make_model"):
        driver.make_model = lambda ctx: fp8_model(driver.reference_model(ctx))
    elif mode == "control":
        def make_state(ctx, cfg):
            from coponerf_tpu_torch.training.trainer import create_train_state

            model = fp8_model(driver.reference_model(ctx))
            return create_train_state(cfg, ctx.config["image_size"], ctx.device, model=model)
        driver.make_state = make_state
    elif mode == "half_batch":
        step = driver.step
        driver.step = lambda state, batch, cfg: step(state, half(batch), cfg)
    elif mode != "program":
        raise ValueError(mode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--as", dest="mode", default="program", choices=("program", "control", "half_batch", "perturbed"))
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    bench, cell, config, traffic = harness.load_cell(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    plant(driver, args.mode)
    compare = driver.compare
    for seed in [int(s) for s in args.seeds.split(",")]:
        detail = {}
        driver.compare = lambda *a, **kw: compare(*a, detail=detail, **kw)
        ctx = harness.Context(workload=cell["name"], seed=seed, seconds=args.seconds, trace=False, cell=cell,
                              config=config, traffic=traffic, device=device, t0=time.perf_counter(),
                              log=harness.log)
        t = time.perf_counter()
        out = driver.run(ctx)
        print(json.dumps({"workload": cell["name"], "as": args.mode, "seed": seed, "checks": out.checks,
                          "detail": detail, "attempted": out.attempted, "failed": out.failed,
                          "seconds": time.perf_counter() - t}), flush=True)
        del out
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
