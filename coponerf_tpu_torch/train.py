"""Training entry point of the port.

    python -m coponerf_tpu_torch.train --experiment_name X --data_root ... --pose_root ... \
        [--dataset realestate10k|acid|synthetic] [--val_root ...] [--fast --compute_dtype bfloat16] \
        [--pose --cycle --ssim] [--device cpu] [--gpus N] ...

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
(``--seed``), a checkpoint of the port (``.pt``), one of the JAX package
(``.npz``, ``utils/jax_checkpoint.py``: any of its layouts) or the
reference's weights (``.pth``, weights only).  A ``.pt`` or ``.npz`` resumes
the run whole: weights, BatchNorm statistics, Adam's moments and the
counters, and with them the learning rate.  Checkpoints,
``metrics.jsonl`` and the summaries go under
``<logging_root>/<experiment_name>/``.  ``--debug_nans`` raises at the
first NaN of a step instead of skipping the step.  ``--flat_opt`` and
``--ufc_scan`` mean what they mean to the JAX entry: Adam over one vector
of every parameter (a ``.pt`` or ``.npz`` of either optimizer layout
resumes it), and the scan layout of the UFC in the checkpoints.  The port's
modules keep the loop layout (the math is the same), so that layout
exists only in the JAX package's ``.npz``: ``--ufc_scan`` writes the
checkpoints as such files (``utils/jax_checkpoint.py:save``, in the run's
optimizer layout), which the JAX entry's ``--checkpoint_path`` resumes
in a run of the same flags.

``--gpus N`` trains data-parallel on N ranks (``parallel/``): one process
and one card a rank on NCCL, or with ``--device cpu`` N CPU processes on
gloo.  ``--batch_size`` is the global batch and must divide by N; each
rank trains on its rows of every global batch (synthetic: every rank makes
the same global batch from the seed and keeps its rows; a dataset: the
loader reads only the rank's rows), and the step is the one-rank step on
the global batch.  Every rank reads ``--checkpoint_path``.  Rank 0 alone
logs, checkpoints and validates while the others wait for it.  More
ranks than visible cards, or a batch that does not divide, exit 2.  Under
``torchrun`` (its ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` environment) the
process joins that group instead of spawning.
"""

from __future__ import annotations

import argparse
import os
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
    p.add_argument("--batch_size", type=int, default=12, help="the global batch, over all ranks")
    p.add_argument("--gpus", type=int, default=1,
                   help="data-parallel ranks: one CUDA device each (NCCL), or CPU processes with --device cpu (gloo)")
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
                   help="resume from a checkpoint of the port (.pt) or of the JAX package (.npz), or start "
                        "from the reference's weights (.pth)")
    p.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--synthetic_pool", type=int, default=0,
                   help="synthetic dataset: generate N batches once and cycle them")
    p.add_argument("--fast", action="store_true", default=False,
                   help="throughput config: K1/K4 sampling of the small levels "
                        "(use with --compute_dtype bfloat16)")
    p.add_argument("--no_remat", action="store_true", default=False,
                   help="keep the UFC activations instead of recomputing them in the backward")
    p.add_argument("--flat_opt", action="store_true", default=False,
                   help="Adam over one vector of every parameter (optax.flatten); a checkpoint keeps this "
                        "optimizer layout, and a resume converts a file of the other")
    p.add_argument("--ufc_scan", action="store_true", default=False,
                   help="checkpoint the UFC in the JAX package's ufc_scan layout, which only its .npz has: the "
                        "checkpoints are written as that .npz, not .pt (the modules and the math are the same)")
    p.add_argument("--seed", type=int, default=0, help="seed of the parameter fill")
    p.add_argument("--debug_nans", action="store_true", default=False,
                   help="raise at the first NaN of a step instead of skipping the step (slow: debugging only)")
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


def make_dataset(opt, mesh=None):
    """(an endless generator of numpy batches, steps_per_epoch or 0 when
    unbounded, the image size: ``--image_size`` for synthetic scenes, the
    readers' for a dataset).  Under ``mesh`` the batches are this rank's
    rows of the global batches."""
    if opt.dataset == "synthetic":
        batches = synthetic_batches(opt.batch_size, opt.image_size, opt.query_sparsity, opt.synthetic_pool)
        if mesh is not None:
            from coponerf_tpu_torch.parallel.mesh import shard_batch

            batches = (shard_batch(mesh, b) for b in batches)
        return batches, 0, opt.image_size
    from coponerf_tpu_torch.data.loader import make_loader

    ds = _dataset_class(opt.dataset)(opt.data_root, opt.pose_root, num_ctxt_views=opt.views, num_query_views=1,
                                     query_sparsity=opt.query_sparsity, augment=True)
    rank, world = (0, 1) if mesh is None else (mesh.coord("data"), mesh.size("data"))
    it = make_loader(ds, opt.batch_size, shuffle=True, num_workers=opt.num_workers, rank=rank, world=world)
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


def build_config(opt, image_size: int, steps_per_epoch: int):
    from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig

    return Config(
        # the cyclic-consistency masks at the image's resolution (256 by default)
        model=ModelConfig(n_view=opt.views, compute_dtype=opt.compute_dtype, fast_sampling=opt.fast,
                          remat_ufc=not opt.no_remat, mask_upsample=image_size, ufc_scan=opt.ufc_scan),
        loss=LossConfig(pose=opt.pose, cycle=opt.cycle, ssim=opt.ssim),
        train=TrainConfig(lr=opt.lr, steps_til_summary=opt.steps_til_summary,
                          epochs_til_ckpt=opt.epochs_til_ckpt, iters_til_ckpt=opt.iters_til_ckpt,
                          steps_per_epoch=steps_per_epoch, seed=opt.seed, debug_nans=opt.debug_nans,
                          flat_optimizer=opt.flat_opt),
        logging_root=opt.logging_root,
        experiment_name=opt.experiment_name,
    )


def run(opt, cfg, device, batches, image_size: int, mesh=None) -> int:
    """Train on this process's device over ``batches``, as rank
    ``mesh.rank`` of ``mesh`` or alone."""
    from coponerf_tpu_torch.training import checkpoint as ckpt_lib
    from coponerf_tpu_torch.training import trainer

    lead = mesh is None or mesh.rank == 0
    try:
        val_fn = make_validation(opt, cfg, image_size) if lead else None
        state = trainer.create_train_state(cfg, image_size, device)
        if opt.checkpoint_path and opt.checkpoint_path.endswith(".pth"):
            ckpt_lib.load_weights(state.model, opt.checkpoint_path, image_size)
            if lead:
                print(f"Loaded the reference weights {opt.checkpoint_path}")
        elif opt.checkpoint_path:
            ckpt_lib.restore_into(state, opt.checkpoint_path)
            if lead:
                print(f"Loaded {opt.checkpoint_path} at step {state.step}")
        if opt.ufc_scan:
            from coponerf_tpu_torch.utils.jax_checkpoint import save
        else:
            save = ckpt_lib.save
        trainer.train(cfg, batches, num_steps=opt.max_steps, state=state, device=device, val_fn=val_fn, mesh=mesh,
                      save=save)
    finally:
        batches.close()     # stops the loader's worker processes
    return 0


def run_rank(rank: int, world_size: int, opt, cfg) -> int:
    """One rank of a data-parallel run, in its own process, its group joined."""
    import torch

    from coponerf_tpu_torch.parallel.mesh import make_mesh

    device = torch.device("cuda", torch.cuda.current_device()) if opt.device == "cuda" else torch.device("cpu")
    mesh = make_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes)
    batches, _, image_size = make_dataset(opt, mesh)
    return run(opt, cfg, device, batches, image_size, mesh)


def main(argv=None) -> int:
    opt = parse_with_config(build_parser(), argv)
    import torch

    from coponerf_tpu_torch.parallel import mesh as mesh_lib

    if opt.device == "cuda" and not torch.cuda.is_available():
        print("train: no CUDA device; pass --device cpu to train on the CPU", file=sys.stderr)
        return 2
    backend = "nccl" if opt.device == "cuda" else "gloo"
    world = int(os.environ["WORLD_SIZE"]) if mesh_lib.in_torchrun() else opt.gpus
    if world < 1 or opt.batch_size % world:
        print(f"train: --batch_size {opt.batch_size} (the global batch) does not split over {world} ranks",
              file=sys.stderr)
        return 2
    if opt.device == "cuda" and opt.gpus > torch.cuda.device_count():
        print(f"train: --gpus {opt.gpus} but {torch.cuda.device_count()} CUDA device(s) visible", file=sys.stderr)
        return 2
    batches, steps_per_epoch, image_size = make_dataset(opt)
    cfg = build_config(opt, image_size, steps_per_epoch)
    if opt.gpus == 1 and not mesh_lib.in_torchrun():
        return run(opt, cfg, torch.device(opt.device), batches, image_size)
    batches.close()         # each rank makes its own
    if mesh_lib.in_torchrun():
        rank, world = mesh_lib.init_from_env(backend)
        try:
            return run_rank(rank, world, opt, cfg)
        finally:
            torch.distributed.destroy_process_group()
    import tempfile

    from coponerf_tpu_torch.parallel.launch import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        devices = [f"cuda:{r}" for r in range(opt.gpus)] if opt.device == "cuda" else None
        threads = None if opt.device == "cuda" else max(1, (os.cpu_count() or 1) // opt.gpus)
        run_ranks(run_rank, opt.gpus, backend, f"file://{tmp}/rendezvous", args=(opt, cfg), devices=devices,
                  threads=threads, deadline_s=None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
