"""Training entry point of the port.

    python -m coponerf_tpu_torch.train --experiment_name X --data_root ... --pose_root ... \
        [--dataset realestate10k|acid|synthetic] [--val_root ...] [--fast --compute_dtype bfloat16] \
        [--pose --cycle --ssim] [--device cpu] ...

The flags are those of the JAX package's ``train.py`` that this port
supports (``--l2_coeff``, ``--depth`` and ``--num_epochs`` are accepted and
inert, as there).  The run goes on the CUDA device unless ``--device cpu``
is given; without a CUDA device and without that flag it exits 2.  Real
datasets stream through the prefetching loader (``data/loader.py``,
``--num_workers`` processes, shuffled, augmented); the learning rate then
decays once an epoch of ``len(dataset) // batch_size`` steps.  With
``--val_root``, ``--val_batches`` full validation images are rendered,
scored and summarised every ``--steps_til_summary`` steps
(``training/validation.py``).  Weights start from the seeded fill
(``--seed``), a checkpoint of the port (``.pt``, optimizer state included)
or the reference's weights (``.pth``, weights only).  Checkpoints,
``metrics.jsonl`` and the summaries go under
``<logging_root>/<experiment_name>/``.
"""

from __future__ import annotations

import argparse
import sys

from coponerf_tpu_torch.utils.cli import parse_with_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--logging_root", type=str, default="logs")
    p.add_argument("--data_root", type=str, default="")
    p.add_argument("--pose_root", type=str, default="")
    p.add_argument("--val_root", type=str, default=None)
    p.add_argument("--val_pose_root", type=str, default=None)
    p.add_argument("--dataset", type=str, default="realestate10k", choices=["realestate10k", "acid", "synthetic"])
    p.add_argument("--experiment_name", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--views", type=int, default=2)
    p.add_argument("--n_skip", type=int, default=50, help="accepted as the JAX entry accepts it")
    p.add_argument("--image_size", type=int, default=256, help="synthetic scenes' size (a dataset's is 256)")
    p.add_argument("--lr", type=float, default=5e-5 * 4)
    p.add_argument("--l2_coeff", type=float, default=0.05, help="inert, as in the reference")
    p.add_argument("--num_epochs", type=int, default=40001, help="inert: --max_steps bounds the run")
    p.add_argument("--max_steps", type=int, default=1000000)
    p.add_argument("--query_sparsity", type=int, default=192)
    p.add_argument("--num_workers", type=int, default=8, help="loader worker processes (reference train.py:89-90)")
    p.add_argument("--cycle", action="store_true", default=False)
    p.add_argument("--pose", action="store_true", default=False)
    p.add_argument("--ssim", action="store_true", default=False)
    p.add_argument("--depth", action="store_true", default=False, help="inert, as in the reference")
    p.add_argument("--epochs_til_ckpt", type=int, default=100)
    p.add_argument("--val_batches", type=int, default=2,
                   help="validation images per summary interval (reference wrapper.py:160-254)")
    p.add_argument("--steps_til_summary", type=int, default=500)
    p.add_argument("--iters_til_ckpt", type=int, default=10000)
    p.add_argument("--checkpoint_path", default=None,
                   help="a checkpoint written by the port (.pt) or the reference's weights (.pth)")
    p.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--synthetic_pool", type=int, default=0,
                   help="synthetic dataset: generate N batches once and cycle them")
    p.add_argument("--fast", action="store_true", default=False,
                   help="throughput config: K1/K4 sampling of the small levels "
                        "(use with --compute_dtype bfloat16)")
    p.add_argument("--no_remat", action="store_true", default=False,
                   help="keep the UFC activations instead of recomputing them in the backward")
    p.add_argument("--seed", type=int, default=0, help="seed of the parameter fill")
    return p


def synthetic_batches(batch_size: int, image_size: int, n_rays: int, pool: int = 0):
    """An endless stream of seeded synthetic batches (seeds 1, 2, ...), or
    of the first ``pool`` of them, cycled."""
    from coponerf_tpu_torch.data.synthetic import make_batch

    def gen(seed):
        return make_batch(batch_size=batch_size, image_size=image_size, n_rays=n_rays, seed=seed)[0]

    if pool:
        batches = [gen(s + 1) for s in range(pool)]
        i = 0
        while True:
            yield batches[i % pool]
            i += 1
    seed = 0
    while True:
        seed += 1
        yield gen(seed)


def _dataset_class(name: str):
    """The training-time reader of ``--dataset`` (query views sampled near
    the context pair)."""
    if name == "acid":
        from coponerf_tpu_torch.data import acid

        return acid.ACID
    from coponerf_tpu_torch.data import realestate

    return realestate.RealEstate10k


def make_dataset(opt):
    """(an endless generator of numpy batches, steps_per_epoch or 0 when
    unbounded, the image size: ``--image_size`` for synthetic scenes, the
    readers' for a dataset)."""
    if opt.dataset == "synthetic":
        return (synthetic_batches(opt.batch_size, opt.image_size, opt.query_sparsity, opt.synthetic_pool), 0,
                opt.image_size)
    from coponerf_tpu_torch.data.loader import make_loader

    ds = _dataset_class(opt.dataset)(opt.data_root, opt.pose_root, num_ctxt_views=opt.views, num_query_views=1,
                                     query_sparsity=opt.query_sparsity, augment=True)
    it = make_loader(ds, opt.batch_size, shuffle=True, num_workers=opt.num_workers)
    return (b for b, _ in it), max(1, len(ds) // opt.batch_size), ds.cfg.image_size


def make_validation(opt, cfg, image_size: int):
    """``val_fn`` over the first ``--val_batches`` scenes of ``--val_root``
    (full query images, no augmentation), or None."""
    if not opt.val_root:
        return None
    from coponerf_tpu_torch.data.scene_dataset import batch_iterator
    from coponerf_tpu_torch.training.validation import make_val_fn

    val_ds = _dataset_class(opt.dataset)(opt.val_root, opt.val_pose_root or opt.pose_root,
                                         num_ctxt_views=opt.views, num_query_views=1, query_sparsity=None,
                                         augment=False)
    val_batches = []
    for vb in batch_iterator(val_ds, batch_size=1, shuffle=False):
        val_batches.append(vb)
        if len(val_batches) >= opt.val_batches:
            break
    return make_val_fn(cfg, val_batches, image_size=image_size, max_batches=opt.val_batches)


def main(argv=None) -> int:
    opt = parse_with_config(build_parser(), argv)
    import torch

    if opt.device == "cuda" and not torch.cuda.is_available():
        print("train: no CUDA device; pass --device cpu to train on the CPU", file=sys.stderr)
        return 2
    from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
    from coponerf_tpu_torch.training import checkpoint as ckpt_lib
    from coponerf_tpu_torch.training import trainer

    batches, steps_per_epoch, image_size = make_dataset(opt)
    cfg = Config(
        # the cyclic-consistency masks at the image's resolution (256 by default)
        model=ModelConfig(n_view=opt.views, compute_dtype=opt.compute_dtype, fast_sampling=opt.fast,
                          remat_ufc=not opt.no_remat, mask_upsample=image_size),
        loss=LossConfig(pose=opt.pose, cycle=opt.cycle, ssim=opt.ssim),
        train=TrainConfig(lr=opt.lr, steps_til_summary=opt.steps_til_summary,
                          epochs_til_ckpt=opt.epochs_til_ckpt, iters_til_ckpt=opt.iters_til_ckpt,
                          steps_per_epoch=steps_per_epoch, seed=opt.seed),
        logging_root=opt.logging_root,
        experiment_name=opt.experiment_name,
    )
    val_fn = make_validation(opt, cfg, image_size)
    device = torch.device(opt.device)
    state = trainer.create_train_state(cfg, image_size, device)
    if opt.checkpoint_path and opt.checkpoint_path.endswith(".pth"):
        ckpt_lib.load_weights(state.model, opt.checkpoint_path, image_size)
        print(f"Loaded the reference weights {opt.checkpoint_path}")
    elif opt.checkpoint_path:
        ckpt_lib.restore_into(state, opt.checkpoint_path)
        print(f"Loaded {opt.checkpoint_path} at step {state.step}")
    try:
        trainer.train(cfg, batches, num_steps=opt.max_steps, state=state, device=device, val_fn=val_fn)
    finally:
        batches.close()     # stops the loader's worker processes
    return 0


if __name__ == "__main__":
    sys.exit(main())
