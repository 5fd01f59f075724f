"""Training entry point of the port.

    python -m coponerf_tpu_torch.train --experiment_name X --dataset synthetic \
        [--fast --compute_dtype bfloat16] [--pose --cycle --ssim] [--device cpu] ...

The flags are those of the JAX package's ``train.py`` that this port
supports.  The run goes on the CUDA device unless ``--device cpu`` is given;
without a CUDA device and without that flag it exits non-zero.  Weights
start from the seeded fill (``--seed``) or from a checkpoint of the port
(``--checkpoint_path``); checkpoints and ``metrics.jsonl`` go under
``<logging_root>/<experiment_name>/``.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--logging_root", type=str, default="logs")
    p.add_argument("--experiment_name", type=str, required=True)
    p.add_argument("--dataset", type=str, default="synthetic", choices=["synthetic"],
                   help="synthetic stereo scenes (the real-dataset loaders are not ported yet)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=5e-5 * 4)
    p.add_argument("--max_steps", type=int, default=1000000)
    p.add_argument("--query_sparsity", type=int, default=192)
    p.add_argument("--cycle", action="store_true", default=False)
    p.add_argument("--pose", action="store_true", default=False)
    p.add_argument("--ssim", action="store_true", default=False)
    p.add_argument("--epochs_til_ckpt", type=int, default=100)
    p.add_argument("--steps_til_summary", type=int, default=500)
    p.add_argument("--iters_til_ckpt", type=int, default=10000)
    p.add_argument("--checkpoint_path", default=None, help="a checkpoint written by the port (.pt)")
    p.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--fast", action="store_true", default=False,
                   help="throughput config: K1/K4 sampling of the small levels "
                        "(use with --compute_dtype bfloat16)")
    p.add_argument("--no_remat", action="store_true", default=False,
                   help="keep the UFC activations instead of recomputing them in the backward")
    p.add_argument("--seed", type=int, default=0, help="seed of the parameter fill")
    return p


def synthetic_batches(batch_size: int, image_size: int, n_rays: int):
    """An endless stream of seeded synthetic batches (seeds 1, 2, ...)."""
    from coponerf_tpu_torch.data.synthetic import make_batch

    seed = 0
    while True:
        seed += 1
        yield make_batch(batch_size=batch_size, image_size=image_size, n_rays=n_rays, seed=seed)[0]


def main(argv=None) -> int:
    opt = build_parser().parse_args(argv)
    import torch

    if opt.device == "cuda" and not torch.cuda.is_available():
        print("train: no CUDA device; pass --device cpu to train on the CPU", file=sys.stderr)
        return 2
    from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
    from coponerf_tpu_torch.training import checkpoint as ckpt_lib
    from coponerf_tpu_torch.training import trainer

    cfg = Config(
        # the cyclic-consistency masks at the image's resolution (256 by default)
        model=ModelConfig(compute_dtype=opt.compute_dtype, fast_sampling=opt.fast,
                          remat_ufc=not opt.no_remat, mask_upsample=opt.image_size),
        loss=LossConfig(pose=opt.pose, cycle=opt.cycle, ssim=opt.ssim),
        train=TrainConfig(lr=opt.lr, steps_til_summary=opt.steps_til_summary,
                          epochs_til_ckpt=opt.epochs_til_ckpt, iters_til_ckpt=opt.iters_til_ckpt,
                          seed=opt.seed),
        logging_root=opt.logging_root,
        experiment_name=opt.experiment_name,
    )
    device = torch.device(opt.device)
    state = trainer.create_train_state(cfg, opt.image_size, device)
    if opt.checkpoint_path:
        ckpt_lib.restore_into(state, opt.checkpoint_path)
        print(f"Loaded {opt.checkpoint_path} at step {state.step}")
    batches = synthetic_batches(opt.batch_size, opt.image_size, opt.query_sparsity)
    trainer.train(cfg, batches, num_steps=opt.max_steps, state=state, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
